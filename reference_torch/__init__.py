"""Plain float32 references of model configurations that the port runs, in
plain ``torch``, outside both packages."""
