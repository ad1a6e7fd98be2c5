"""Quantizer math and placement policy."""
