"""Distribution over ranks: column blocks, halo exchange and the sharded
time loop (``mesh``), and a launcher that runs it in spawned processes
(``launch``)."""
