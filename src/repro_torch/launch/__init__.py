"""Launch-side analytics of the port: the roofline model (``roofline``)."""
