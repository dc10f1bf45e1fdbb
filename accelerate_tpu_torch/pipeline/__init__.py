"""Training-step construction (:mod:`.train_step`)."""
