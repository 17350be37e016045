"""Flagship LM line: NGram token windows → torch loader → transformer LM
AdamW steps on the card → KV-cache sampling."""
