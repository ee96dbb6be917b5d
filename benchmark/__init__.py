"""The benchmark of the PyTorch and CUDA port (`autoprog_tpu_torch`): see
README.md. Importing it loads nothing of the program."""
