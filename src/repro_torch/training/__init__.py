"""Training of the port: AdamW with its schedule, gradient compression and
the train step (``make_train_step``, ``init_train_state``)."""
