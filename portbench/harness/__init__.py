"""The benchmark's general machinery: finding a cell's files
(:mod:`.spec`), driving the port (:mod:`.program`), the timed window and
the traced stretches (:mod:`.window`, :mod:`.trace`), and the
comparison with the reference that decides ``correct`` (:mod:`.judge`).
"""
