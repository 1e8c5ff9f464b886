"""Host-side utilities: config, evaluation, synthetic scenes, state conversion."""
