"""The fused visit: ``ref`` (one launch in plain PyTorch) and ``ops``
(the chunk launcher around ``csrc/fused_visit.cu``)."""
