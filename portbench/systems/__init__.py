"""One module per kind of configuration (a config file's ``system``)."""
