"""One ACL push round: ``ref`` (plain PyTorch) and ``ops`` (the wrapper of
``csrc/ppr_push.cu``)."""
