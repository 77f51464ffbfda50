"""Command-line tools of the port: mesh preprocessing for training data."""
