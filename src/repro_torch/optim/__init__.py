"""Optimizers of the LM's training path: AdamW and Adafactor with
warmup-cosine and global-norm clipping (:mod:`.adamw`), and int8 gradient
compression with error feedback (:mod:`.compress`)."""
