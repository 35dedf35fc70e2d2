"""Training of the port's LMs (``loop.make_train_step``)."""
