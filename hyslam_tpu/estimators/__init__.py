"""Geometric estimators: batched RANSAC solvers (two-view H/F, EPnP, Sim3)
— the array-native src/estimators (SURVEY.md §2.6)."""
