"""Runtime resilience (the port of ``ml_recipe_tpu/resilience/``): the
background checkpoint persist (``checkpoint_async.py``). The supervisor,
watchdog, fault sites and coordination are not ported (ROADMAP.md queue 1,
'Runtime subsystems')."""
