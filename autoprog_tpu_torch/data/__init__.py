"""Host input pipeline of the port (datasets, loader, augmentation, mixup) and its device-side token-label pieces."""
