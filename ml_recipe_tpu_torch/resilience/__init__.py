"""Runtime resilience (the port of ``ml_recipe_tpu/resilience/``): the
background checkpoint persist (``checkpoint_async.py``) and the child
exit-code classes (``supervisor.py``: ``CLEAN``, ``classify_exit``). The
supervisor itself, the watchdog, fault sites and coordination are not
ported (ROADMAP.md queue 1, 'Runtime subsystems')."""
