"""Distributed-training math of the port (the per-worker parts of
``paddle_tpu/parallel``; the collective forms come with multi-card
training)."""
