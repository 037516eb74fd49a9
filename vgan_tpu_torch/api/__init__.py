"""Estimator classes."""
