"""Architecture configs of the LM stack (the dense family)."""
