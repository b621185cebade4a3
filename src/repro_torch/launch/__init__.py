"""Launch side of the port: the roofline model (``roofline``), the training
entry point (``train``), the serving entry point (``serve``) and the serve
mesh (``mesh``)."""
