"""Serving front ends of the port: LM decode and multi-tenant graph queries.

``engine.py`` serves LM decode through continuous batching;
``graph_server.py`` serves mixed graph-query traffic over the streaming
executors with concurrent admission, pump and delivery lanes
(``dispatch.py``), warm engine bundles (``compile_cache.py``) and a
byte-budgeted LRU of completed result planes (``result_cache.py``).
"""
from repro_torch.serve.compile_cache import (MegastepCache,  # noqa
                                             build_warm_megastep,
                                             session_uid, warm_key)
from repro_torch.serve.engine import (ContinuousBatcher, Request,  # noqa
                                      SlotInfo, greedy_sample, insert_slot,
                                      make_decode_step, make_prefill_step)
from repro_torch.serve.graph_server import (SERVABLE_KINDS,  # noqa
                                            GraphRequest, GraphResponse,
                                            GraphServer, default_autoscaler)
from repro_torch.serve.result_cache import (CacheEntry, ResultCache,  # noqa
                                            result_key)
