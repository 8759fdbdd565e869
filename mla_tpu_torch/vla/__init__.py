"""Data fixtures of the VLA pipeline."""
