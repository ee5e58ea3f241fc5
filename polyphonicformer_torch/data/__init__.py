"""Training data: batch structures and seeded synthetic batches."""
