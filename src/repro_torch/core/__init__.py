"""SDV machine descriptions (with the H100 constants) and the Hopper SELL tuner."""
