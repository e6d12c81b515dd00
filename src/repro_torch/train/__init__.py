"""Training side of the port. Only the checkpoint reader so far
(`checkpoint`); the writer, the optimizer and the train step come with the
training slice."""
