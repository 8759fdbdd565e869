"""Host-side pieces of the VLA pipeline: synthetic batches and the action
tokenizer."""
