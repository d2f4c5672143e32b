"""Host data path of the port: dataset preparation, image ops,
augmentation and the batch loader."""
