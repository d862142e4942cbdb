"""Tensor operations of the port: spectral rows, Haar, extraction, matching."""
