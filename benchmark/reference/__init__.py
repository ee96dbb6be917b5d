"""The plain float32 reference: VOLO and DeiT forwards, their losses,
autograd, AdamW and the EMA sweeps. It imports nothing of the program."""
