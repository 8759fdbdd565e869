"""Model presets."""
