"""Pure tensor operations of one slot: tariff, thermal, battery, observation,
market clearing and the factored market with its merged-min kernel."""
