"""Synthetic data for the paper's workloads (numpy only) and the LM
training pipeline built on HiFrames (``pipeline``, imported on use)."""
