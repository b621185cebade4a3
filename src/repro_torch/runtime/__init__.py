"""Runtime helpers of the port: the LATEST-marker commit protocol and crash
injection for the durable write path."""
