"""Command-line entry points (``serve``, ``serve_broker``, ``train``), the
meshes (``mesh``) and the cells of a sharded run (``specs``)."""
