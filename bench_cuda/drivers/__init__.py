"""The timed loops a traffic file names by its ``driver`` key."""
