"""Model layer: CLIP towers, T5 encoder + greedy decode, the MPR_Gen model
and its variants (text-only, prediction head, BAN fusion)."""
