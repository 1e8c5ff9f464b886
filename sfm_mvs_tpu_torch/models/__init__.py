"""Pipeline state and drivers: map store, two-view bootstrap, incremental SfM."""
