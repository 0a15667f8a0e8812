"""Examples run on the port (each mirrors one under ``example/``)."""
