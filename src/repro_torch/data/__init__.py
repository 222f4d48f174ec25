"""Synthetic data for the paper's workloads (numpy only)."""
