"""The train and eval steps of the port, and data parallelism: one process
per card (``mesh``), the strategy planner (``plan``), replicated decisions
(``consensus``), ZeRO-1 (``zero``) and the CLI's per-card launcher
(``launch``)."""
