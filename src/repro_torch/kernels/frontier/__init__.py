"""The Δ-window frontier tile: ``ref`` (plain PyTorch) and ``ops``
(the wrapper of ``csrc/frontier.cu``)."""
