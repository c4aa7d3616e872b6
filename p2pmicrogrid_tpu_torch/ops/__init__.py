"""Pure tensor operations of one slot: tariff, thermal, battery, observation,
market clearing, the factored market with its merged-min kernel, and the
matrix negotiation's kernels."""
