"""Launch side of the port: the roofline model (``roofline``) and the
training driver (``train``)."""
