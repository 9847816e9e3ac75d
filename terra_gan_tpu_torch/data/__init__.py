"""Training data of the port: tile datasets and the batch loader."""
