"""Blocked online-softmax attention: the prefill's attention kernel."""
