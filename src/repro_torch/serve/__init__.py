"""Serving front end of the port: LM decode through continuous batching.

The graph-query server waits for ROADMAP A11.
"""
from repro_torch.serve.engine import (ContinuousBatcher, Request,  # noqa
                                      SlotInfo, greedy_sample, insert_slot,
                                      make_decode_step, make_prefill_step)
