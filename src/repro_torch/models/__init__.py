"""Models of the port: the dense GQA decoder family (``transformer``)."""
