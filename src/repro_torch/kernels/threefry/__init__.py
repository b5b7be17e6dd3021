"""The threefry-2x32 draw: ``ref`` (plain PyTorch) and ``ops`` (the
wrapper around ``csrc/threefry.cu``)."""
