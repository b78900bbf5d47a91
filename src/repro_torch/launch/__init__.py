"""Serving entry points of the port's backbone (``serve_backbone``), the
serve steps they run (``steps``), and the federated mesh spec (``mesh``)."""
