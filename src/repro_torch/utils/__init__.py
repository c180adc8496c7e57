"""Small helpers shared by the port: hardware constants, parameter trees,
device selection."""
