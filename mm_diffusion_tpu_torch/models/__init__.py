"""Models of the PyTorch port: the MM-UNet and the SR U-Net."""
