"""Host data layer of the port (numpy): the VOC instance dataset and its
in-memory fake, the default train/val transform stacks, guidance synthesis
and the threaded loader."""
