"""Launch entry points (the port of the reference's ``launch/``): serving."""
