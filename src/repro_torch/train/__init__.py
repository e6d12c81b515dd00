"""Training side of the port: the optimizers (`optimizer`), the train step
(`train_step`), the data stream and its prefetcher (`data`), int8
error-feedback compression (`compression`) and the checkpoint reader and
writer (`checkpoint`)."""
