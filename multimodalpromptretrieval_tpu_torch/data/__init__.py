"""Host-side data layer: dataset parsers, the preprocessed-image cache,
fixed-shape batching and the synthetic SLAKE corpus."""
