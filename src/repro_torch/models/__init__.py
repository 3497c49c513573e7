"""The LM substrate of the port: dense decoders (``config``, ``common``,
``lm``, ``api``) and the parameter crossing from the JAX package
(``params``)."""
