"""The general loops that feed the program one kind of traffic each, found
by the ``driver`` a traffic mix names."""
