"""The port's gate on the card, by path; ``chip_smoke.py`` runs it.

``refs`` holds what the phases are held to, as data the CPU tests read;
``common`` what every phase shares; ``kernels``, ``federation``,
``serve`` and ``train`` the phases, each gate in its phase's docstring.
"""
