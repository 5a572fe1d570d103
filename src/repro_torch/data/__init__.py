"""Synthetic data pipeline of the port (own copy of `repro/data/`)."""
