"""Training and prediction steps of the port."""
