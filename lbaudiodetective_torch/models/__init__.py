"""Front-end objects of the port."""
