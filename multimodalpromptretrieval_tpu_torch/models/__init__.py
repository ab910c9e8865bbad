"""Model layer: CLIP towers, T5 encoder + greedy decode, MPR_Gen prefix
model (serving path)."""
