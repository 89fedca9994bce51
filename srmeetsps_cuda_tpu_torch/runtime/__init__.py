"""The outer loop: preparation, iteration, stopping, outputs."""
