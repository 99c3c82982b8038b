"""Host utilities: JSONL metrics and checkpoints."""
