"""Distribution: the logical-axis sharding rules (``sharding``), the
mesh collectives and the int8 gradient compression (``collectives``), and
spawning ranks (``ranks``)."""
