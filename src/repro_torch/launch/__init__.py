"""Serving entry points of the port's backbone (``serve_backbone``) and the
serve steps they run (``steps``)."""
