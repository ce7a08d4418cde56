"""The benchmark's plain reference (``aerobulk``) and the comparison that
decides ``correct`` (``check``); neither imports the program."""
