"""Launch side of the port: the roofline model (``roofline``), the training
entry point (``train``), the serving entry point (``serve``), the meshes
(``mesh``), the sharding rules and placed trees (``sharding``) and the
lockstep collectives (``spmd``)."""
