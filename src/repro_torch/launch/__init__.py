"""Launch: meshes, the ranks behind them, and the training launcher."""
