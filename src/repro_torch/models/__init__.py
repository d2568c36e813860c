"""Model building blocks of the port (``repro.models``): so far the PNA
graph network and the shared initialiser."""
