"""Frozen teacher towers: CLIP text side (``clip``) and its tokenizer."""
