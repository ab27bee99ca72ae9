"""The benchmark's plain reference: frozen copies of the NumPy float64
oracle (``oracle.py``), its constants and its table builders, a plain
KiD loop (``kid.py``) and the WRF-shaped call (``wrf.py``).  It imports
nothing of the program, nor of the JAX package."""
