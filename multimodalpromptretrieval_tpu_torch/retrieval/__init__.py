"""Device-resident retrieval index and pre-tokenized hint tables."""
