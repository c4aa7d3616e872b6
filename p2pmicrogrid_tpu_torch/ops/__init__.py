"""Pure tensor operations of one slot: tariff, thermal, battery, observation,
market clearing, the factored market with its merged-min kernel, the matrix
negotiation's kernels, and the fused slot's kernel."""
