"""Traffic drivers (``<driver>.py``) and the mixes they run
(``<mix>.json``, each naming its driver)."""
