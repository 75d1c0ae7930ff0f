"""Prediction map viewer (legacy Streamlit app replacement)."""
