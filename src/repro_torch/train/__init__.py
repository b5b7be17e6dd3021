"""Training of the LM stack: AdamW and its schedules, int8 gradient
compression, the synthetic data stream, the train step, checkpoints and the
fault-tolerant loop (the port of the JAX package's ``repro.train``)."""
