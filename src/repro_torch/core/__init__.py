"""Dataset characters, objectives, compression and scalability readouts
(port of ``repro/core``)."""
