"""Thread pool and epoch ventilator of the port."""
