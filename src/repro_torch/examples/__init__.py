"""The reference's eight ``examples/`` on the port, each run as
``python -m repro_torch.examples.<name>`` with the reference's arguments
and ``--device`` (default ``cuda``; ``cpu`` on request):

* ``quickstart``     -- the paper's worked example, checked by BFS;
* ``dynamic_stream`` -- a mixed event stream through ``SPCService``;
* ``serve_spc``      -- async ingest, pinned serving and the front door;
* ``fleet_spc``      -- an updater process and a replica process;
* ``analytics_spc``  -- betweenness, cycles and a PNA re-rank;
* ``gnn_molecule``   -- an EGNN potential, trained, rotation-checked;
* ``serve_lm``       -- prefill and greedy decode of a small LM;
* ``train_lm``       -- the LM training loop with checkpoints.

Each ``main(argv)`` takes the command line's arguments as a list."""
