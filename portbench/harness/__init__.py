"""The benchmark's fixed parts: the cell's files found by name
(:mod:`.spec`), the scenes (:mod:`.scenes`), one run of a cell
(:mod:`.core`), the trace's reduction (:mod:`.trace`), the table of peaks
(:mod:`.roofline`), the check of the loaded modules (:mod:`.modcheck`),
and the faults a run's check must catch (:mod:`.faults`).

Nothing here imports the program under test: the entry modules under
``entries/`` do, inside the functions a run calls.
"""
