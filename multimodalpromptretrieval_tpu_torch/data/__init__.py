"""Host-side data layer: fixed-shape batching and the synthetic SLAKE corpus."""
