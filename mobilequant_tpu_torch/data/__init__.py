"""Calibration data."""
