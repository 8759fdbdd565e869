"""Open-X-Embodiment dataset configs, named mixtures and the MLA suites'
standardization transforms."""
