"""Run tooling around the port's CLI: the published presets
(`hyperparameters.PRESETS`) and the scene sweep (`run_sweep`)."""
