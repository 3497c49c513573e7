"""The plain reference that decides ``correct``: ``step.train_steps``
follows the configuration's train step from the benchmark's own inputs and
imports nothing of the program."""
