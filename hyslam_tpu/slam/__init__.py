"""SLAM policy layer: tracking strategies + state machine, keyframe policy,
mapping jobs, initializers, and the System orchestrator (the array-native
src/slam + src/main, SURVEY.md §2.1-2.3)."""
