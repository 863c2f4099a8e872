"""Data IO of the port. Only the image reader that serving needs is here
(``frame_utils``); the dataset readers come with training."""
