"""Feature system: extraction pipeline, matching engine, vocabulary/BoW —
the array-native src/features (SURVEY.md §2.5)."""
