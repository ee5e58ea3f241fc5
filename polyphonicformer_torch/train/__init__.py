"""Training: losses, assignment, targets, optimizer and the train step."""
