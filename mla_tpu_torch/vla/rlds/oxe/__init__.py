"""Open-X-Embodiment dataset configs, named mixtures, every dataset's
standardization transform and the kwargs factory."""
