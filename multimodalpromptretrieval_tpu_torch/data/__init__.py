"""Host-side data layer: dataset parsers, the preprocessed-image cache,
fixed-shape batching, the synthetic SLAKE corpus and the ROCO question
generator."""
