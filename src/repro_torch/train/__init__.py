"""Training-side utilities of the port (``repro.train``): AdamW
(:mod:`~repro_torch.train.optimizer`), the fault-tolerant loop
(:mod:`~repro_torch.train.loop`) and the checkpoint layer
(:mod:`~repro_torch.train.checkpoint`), which the serving fleet's
``DirTransport`` rides too.  The ZeRO sharding of the optimizer state
waits for the mesh slice.
"""
