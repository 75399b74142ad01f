"""parallel layer of the PyTorch port: the task-sharded runner."""
