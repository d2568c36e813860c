"""Training-side utilities of the port (``repro.train``).

So far the checkpoint layer alone (:mod:`repro_torch.train.checkpoint`),
which the serving fleet's ``DirTransport`` rides; the optimizer and the
training loop are queue 1, item 7 of ROADMAP.md.
"""
